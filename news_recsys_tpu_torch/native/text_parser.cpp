// Fast parser for the reference text feature format:
//   "feat1:val1 feat2:val2 ...\tlabel [label...]\n"
//
// The reference parses this per row in Python inside Dataset.__getitem__
// (src/dataset/DataReader/data_reader.py:56-113) — the data-loading hot
// loop. This library parses the whole file in C++ into packed arrays in one
// pass (sparse -> int32 column, dense -> float32 column, array "1,2,3" ->
// padded int32 (N, max_len) + float32 mask), matching the torch reader's
// truncate/pad semantics.
//
// Build: g++ -O3 -march=native -shared -fPIC -o libtext_parser.so text_parser.cpp

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Column {
  int kind;  // 0 sparse, 1 dense, 2 array
  int max_len;
  int32_t* ints;    // sparse: (N,), array: (N, max_len)
  float* floats;    // dense: (N,), array mask: (N, max_len)
};

struct ParserState {
  std::unordered_map<std::string, Column> cols;
  float* labels;       // (N, n_labels)
  int n_labels;
  int64_t n_rows;
};

}  // namespace

extern "C" {

// Count data lines (rows) in the file.
int64_t tp_count_rows(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  int64_t rows = 0;
  std::string line;
  int c;
  bool nonempty = false;
  while ((c = fgetc(f)) != EOF) {
    if (c == '\n') {
      if (nonempty) rows++;
      nonempty = false;
    } else if (c != '\r' && c != ' ' && c != '\t') {
      nonempty = true;
    }
  }
  if (nonempty) rows++;
  fclose(f);
  return rows;
}

// Parse the file into caller-allocated buffers.
//
// feature_names: '\n'-joined names; kinds: per-feature 0/1/2;
// max_lens: per-feature array max length (0 for non-array).
// int_buffers/float_buffers: per-feature output pointers (see Column).
// labels: (n_rows, n_labels). Returns number of rows parsed, or -1 on error.
int64_t tp_parse(const char* path, const char* feature_names,
                 const int32_t* kinds, const int32_t* max_lens,
                 int32_t n_features, int32_t** int_buffers,
                 float** float_buffers, float* labels, int32_t n_labels) {
  std::unordered_map<std::string, int> name_to_idx;
  {
    std::string names(feature_names);
    size_t start = 0;
    int idx = 0;
    while (start <= names.size() && idx < n_features) {
      size_t end = names.find('\n', start);
      if (end == std::string::npos) end = names.size();
      name_to_idx[names.substr(start, end - start)] = idx++;
      start = end + 1;
    }
  }

  FILE* f = fopen(path, "rb");
  if (!f) return -1;

  std::vector<char> buf(1 << 20);
  std::string line;
  int64_t row = 0;

  while (fgets(buf.data(), (int)buf.size(), f)) {
    line.assign(buf.data());
    // handle very long lines
    while (!line.empty() && line.back() != '\n' &&
           fgets(buf.data(), (int)buf.size(), f)) {
      line += buf.data();
    }
    while (!line.empty() && (line.back() == '\n' || line.back() == '\r')) line.pop_back();
    if (line.empty()) continue;

    size_t tab = line.find('\t');
    if (tab == std::string::npos) { fclose(f); return -2; }

    // features
    size_t pos = 0;
    while (pos < tab) {
      size_t sp = line.find(' ', pos);
      if (sp == std::string::npos || sp > tab) sp = tab;
      size_t colon = line.find(':', pos);
      if (colon == std::string::npos || colon >= sp) { fclose(f); return -3; }
      std::string name = line.substr(pos, colon - pos);
      auto it = name_to_idx.find(name);
      if (it != name_to_idx.end()) {
        int fi = it->second;
        const char* val = line.c_str() + colon + 1;
        char* endp;
        if (kinds[fi] == 0) {  // sparse
          int_buffers[fi][row] = (int32_t)strtol(val, &endp, 10);
        } else if (kinds[fi] == 1) {  // dense
          float_buffers[fi][row] = strtof(val, &endp);
        } else {  // array
          int L = max_lens[fi];
          int32_t* out = int_buffers[fi] + row * L;
          float* mask = float_buffers[fi] + row * L;
          int n = 0;
          const char* p = val;
          while (p < line.c_str() + sp && n < L) {
            out[n] = (int32_t)strtol(p, &endp, 10);
            if (endp == p) break;
            mask[n] = 1.0f;
            n++;
            p = endp;
            if (*p == ',') p++;
            else break;
          }
          for (int j = n; j < L; ++j) { out[j] = 0; mask[j] = 0.0f; }
        }
      }
      pos = sp + 1;
    }

    // labels
    {
      const char* p = line.c_str() + tab + 1;
      char* endp;
      for (int j = 0; j < n_labels; ++j) {
        labels[row * n_labels + j] = strtof(p, &endp);
        p = endp;
        while (*p == ' ') p++;
      }
    }
    row++;
  }
  fclose(f);
  return row;
}
}
