"""Config system: single-YAML contract shared by data pipeline and models.

The port's own copy of :mod:`news_recsys_tpu.config`, field for field, so
that a config travels between the two packages as the plain dict of
:func:`config_to_dict` / :func:`config_from_dict`
(``tests/test_torch_shared.py`` holds the copy to the original).

Mirrors the reference's OmegaConf schema (``train_cf_deep.yaml:1-63``,
``documents/config_file_introduction.md``) — the *same* file drives feature
extraction, the data reader, and the model — but is validated into frozen
dataclasses and extended with a ``mesh`` section (the JAX package's device
mesh; the port runs one device and refuses ``mesh.model > 1``).

The key structural addition over the reference is :class:`FeatureSchema`:
the reference relies on an *implicit* convention that features are
concatenated in sorted-name order and that FM / Wide&Deep slice column 0 of
each field out of the concatenated matrix (``base_model.py:286``,
``fm/model.py:48-59``, ``widedeep/model.py:53-69``). Here that contract is a
first-class object with precomputed dims/offsets, shared by every model.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Tuple

import yaml


# ---------------------------------------------------------------------------
# Dataclasses mirroring the YAML sections
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PathsConfig:
    data_path: str = ""
    out_basedir: str = ""
    user_history_path: str = ""


@dataclass(frozen=True)
class FeaturesConfig:
    sparse_feature_names: Tuple[str, ...] = ()
    dense_feature_names: Tuple[str, ...] = ()
    array_feature_names: Tuple[str, ...] = ()
    item_feature_names: Tuple[str, ...] = ()
    user_feature_names: Tuple[str, ...] = ()
    array_max_length: Dict[str, int] = field(default_factory=dict)
    # feature-generator only: ordered list of features to extract
    feature_names: Tuple[str, ...] = ()


@dataclass(frozen=True)
class EmbeddingsConfig:
    embedding_size: Dict[str, int] = field(default_factory=dict)
    embedding_table_size: Dict[str, int] = field(default_factory=dict)
    share_emb_table_features: Dict[str, str] = field(default_factory=dict)
    # Embedding init: N(0, init_scale). 1.0 = torch nn.Embedding default
    # (reference parity). Models that score DIRECTLY from raw embeddings
    # (LR: sum of dim-1 biases; FM: quadratic form) start deep in sigmoid
    # saturation under N(0,1) — FM's init logit std is ~15 — and the
    # saturation escape dominates (or, under rowwise AdaGrad's decaying
    # step, permanently stalls) training; see artifacts/fm_diagnosis_r05.
    # configs/{lr,fm}.yaml ship the measured-best 0.01.
    init_scale: float = 1.0
    # Pack all LARGE tables of the same embedding dim into one physical
    # "arena_d<D>" parameter (logical ids offset per feature, padding id 0
    # shared): halves the per-step scatter/gather op count when several
    # big tables share a dim (user+item in the MIND config).
    # Changes the param tree (checkpoints are not interchangeable with
    # arena off). Tables below ARENA_MIN_VOCAB keep their own params.
    arena_tables: bool = False


@dataclass(frozen=True)
class DatasetConfig:
    batch_size: int = 512
    num_workers: int = 0          # accepted for reference-config compat; host
    pin_memory: bool = False      # pipeline is array-based, no worker procs
    eval_batch_size: int = 0      # 0 -> use batch_size
    shuffle_seed: int = 42


@dataclass(frozen=True)
class TrainHParams:
    val_freq: int = 1
    max_epoch: int = 30
    lr: float = 1e-3
    min_lr: float = 5e-6
    lr_milestones: Tuple[int, int] = (40000, 200000)
    max_step: int = 300000
    weight_decay: float = 0.01    # torch AdamW default used by the reference
    b1: float = 0.9
    b2: float = 0.999
    seed: int = 42
    ckpt_every_steps: int = 0     # >0: sharded checkpoint every N steps (mid-epoch)
    # "adamw": exact reference semantics (dense moments/decay on all rows).
    # "sparse_adamw": rowwise updates on touched rows only (torch SparseAdam
    # semantics) — the recsys fast path; ~O(B) instead of O(V) table traffic.
    embedding_optimizer: str = "adamw"
    # K-step lazy embedding write-back: with K > 1 the rowwise optimizers
    # buffer K steps of (ids, grads) and apply ONE combined dedup+update
    # every K-th step. Semantics: embeddings see gradient accumulation over
    # K steps (one optimizer step of the summed gradient, lr at the apply
    # step; rows read up to K-1 steps stale); K=1 (default) is the exact
    # per-step path. Requires a rowwise embedding_optimizer; ranking path
    # only. The port runs K=1.
    embedding_update_period: int = 1
    device: str = "tpu"           # reference compat, ignored (default kept so dicts round-trip)
    gpus: Tuple[int, ...] = ()    # reference compat, ignored
    log_every_n_steps: int = 50
    # Runtime thresholds:
    # max train steps fused per device dispatch in the JAX package (the
    # port steps eagerly and does not read it).
    chunk_steps: int = 1024
    # packed datasets up to this many bytes are uploaded to device memory
    # once and trained device-resident; larger ones stream host-gathered
    # slabs in the JAX package (the port refuses them).
    device_resident_bytes: int = 2 << 30
    # validation splits with at least this many rows use the JAX package's
    # device metric engine instead of the host engine (the port: host engine)
    device_metrics_min_rows: int = 200_000


@dataclass(frozen=True)
class MeshConfig:
    """The JAX package's device-mesh layout; the port reads ``model`` (must
    be 1) and the two dtypes (must be float32)."""

    data: int = -1        # -1: all devices on the data axis
    model: int = 1        # row-sharding factor for embedding tables
    param_dtype: str = "float32"
    compute_dtype: str = "float32"   # towers can run bf16; fp32 default
    # the JAX package's explicit collectives for sharded tables
    explicit_collectives: bool = False


@dataclass(frozen=True)
class Config:
    name: str = "model"
    paths: PathsConfig = field(default_factory=PathsConfig)
    features: FeaturesConfig = field(default_factory=FeaturesConfig)
    embeddings: EmbeddingsConfig = field(default_factory=EmbeddingsConfig)
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    train_hparams: TrainHParams = field(default_factory=TrainHParams)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    # Free-form model-specific blocks (e.g. wide_and_deep_cfg, dssm_cfg),
    # mirroring the reference's optional per-model YAML sections.
    extras: Dict[str, Any] = field(default_factory=dict)

    def extra(self, key: str, default: Any = None) -> Any:
        return self.extras.get(key, default)


_SECTION_TYPES = {
    "paths": PathsConfig,
    "features": FeaturesConfig,
    "embeddings": EmbeddingsConfig,
    "dataset": DatasetConfig,
    "train_hparams": TrainHParams,
    "mesh": MeshConfig,
}


def _coerce(cls, raw: Dict[str, Any]):
    """Build dataclass from a raw dict, tuple-ifying lists, keeping extras out."""
    if raw is None:
        raw = {}
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for key, value in raw.items():
        if key not in fields:
            continue  # tolerate unknown keys like the reference's OmegaConf
        if isinstance(value, list):
            value = tuple(value)
        if value is None:
            continue
        kwargs[key] = value
    return cls(**kwargs)


def load_config(path: str) -> Config:
    """Load a YAML config file into a validated :class:`Config`."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"Config file not found: {path}")
    with open(path, "r", encoding="utf-8") as f:
        raw = yaml.safe_load(f) or {}
    return config_from_dict(raw)


def config_to_dict(cfg: Config) -> Dict[str, Any]:
    """Inverse of :func:`config_from_dict`: a YAML-safe plain dict that
    round-trips (tuples become lists). Used by artifact bundles that must
    carry their config with them (:mod:`news_recsys_tpu.serving`)."""

    def plain(x):
        if isinstance(x, tuple):
            return [plain(v) for v in x]
        if isinstance(x, dict):
            return {k: plain(v) for k, v in x.items()}
        return x

    out: Dict[str, Any] = {"name": cfg.name}
    for key, cls in _SECTION_TYPES.items():
        section = getattr(cfg, key)
        out[key] = {f.name: plain(getattr(section, f.name))
                    for f in dataclasses.fields(cls)}
    for key, value in cfg.extras.items():
        out[key] = plain(value)
    return out


def config_from_dict(raw: Dict[str, Any]) -> Config:
    sections = {}
    extras: Dict[str, Any] = {}
    for key, value in raw.items():
        if key == "name":
            continue
        if key in _SECTION_TYPES:
            sections[key] = _coerce(_SECTION_TYPES[key], value)
        else:
            extras[key] = value
    cfg = Config(name=str(raw.get("name", "model")), extras=extras, **sections)
    _validate(cfg)
    return cfg


def _validate(cfg: Config) -> None:
    f = cfg.features
    for fea in f.array_feature_names:
        if fea not in f.array_max_length:
            raise ValueError(
                f"Array feature '{fea}' declared but max_length not defined in config."
            )
    emb = cfg.embeddings
    for fname in tuple(f.sparse_feature_names) + tuple(f.array_feature_names):
        table = emb.share_emb_table_features.get(fname, fname)
        if table not in emb.embedding_size:
            raise ValueError(f"Embedding size for table '{table}' (feature '{fname}') missing.")
        if table not in emb.embedding_table_size:
            raise ValueError(f"Embedding table size for table '{table}' (feature '{fname}') missing.")
    ms = cfg.train_hparams.lr_milestones
    if len(ms) != 2:
        raise ValueError("lr_milestones must have exactly 2 entries (hold end, decay end).")
    if cfg.embeddings.init_scale <= 0:
        raise ValueError(
            f"embeddings.init_scale must be > 0, got {cfg.embeddings.init_scale}.")
    for key in ("param_dtype", "compute_dtype"):
        val = getattr(cfg.mesh, key)
        if val not in ("float32", "bfloat16"):
            raise ValueError(f"mesh.{key} must be 'float32' or 'bfloat16', got {val!r}.")
    opt = cfg.train_hparams.embedding_optimizer
    if opt not in ("adamw", "sparse_adamw", "rowwise_adagrad"):
        raise ValueError(
            f"train_hparams.embedding_optimizer must be one of "
            f"adamw|sparse_adamw|rowwise_adagrad, got {opt!r}.")
    period = cfg.train_hparams.embedding_update_period
    if period < 1:
        raise ValueError(
            f"train_hparams.embedding_update_period must be >= 1, got {period}.")
    if period > 1 and opt == "adamw":
        raise ValueError(
            "embedding_update_period > 1 (lazy embedding write-back) requires "
            "a rowwise embedding_optimizer (sparse_adamw or rowwise_adagrad).")
    if cfg.mesh.param_dtype == "bfloat16" and opt == "adamw":
        # Dense AdamW would keep bf16 moments and apply bf16 arithmetic to the
        # whole table; only the rowwise paths carry fp32 master state and
        # stochastic-round the write-back, so bf16 storage requires one.
        raise ValueError(
            "mesh.param_dtype=bfloat16 requires a rowwise embedding optimizer "
            "(sparse_adamw or rowwise_adagrad: fp32 master state + "
            "stochastic-rounded write-back)."
        )


# ---------------------------------------------------------------------------
# FeatureSchema — the explicit concat/slicing contract
# ---------------------------------------------------------------------------

SPARSE = "sparse"
DENSE = "dense"
ARRAY = "array"

DENSE_FEATURE_DIM = 1  # reference: dense features contribute 1 dim each


# Must match models.embedding.SMALL_VOCAB_THRESHOLD: only tables already on
# the large-table (rowwise-optimizer) path are worth arena packing.
ARENA_MIN_VOCAB = 4096


@dataclass(frozen=True)
class FeatureSpec:
    name: str
    kind: str                 # SPARSE | DENSE | ARRAY
    table: str                # embedding table name (after share aliasing); "" for dense
    dim: int                  # output dim after lookup/pool (1 for dense)
    vocab: int                # table rows (0 for dense)
    max_length: int = 0       # array features only
    offset: int = 0           # start column in the concatenated feature matrix
    id_offset: int = 0        # arena packing: logical id -> arena row shift
                              # (id 0 stays 0; see arena_layout)
    member_vocab: int = 0     # arena packing only: the member table's own
                              # LOGICAL vocab — ids outside [1, member_vocab)
                              # clamp to padding so a corrupt id can never
                              # land in another member's row range


@dataclass(frozen=True)
class FeatureSchema:
    """Sorted-name feature layout for a set of features.

    ``specs`` are ordered by feature name — the same order the reference's
    ``get_embeddings_from_batch`` concatenates (``base_model.py:286``) — and
    each spec carries its column ``offset`` into the concatenated matrix, so
    FM's "column 0 = first-order weight" and Wide&Deep's "column 0 = wide
    part" contracts are explicit (``fm/model.py:48-59``,
    ``widedeep/model.py:53-69``).
    """

    specs: Tuple[FeatureSpec, ...]

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(s.name for s in self.specs)

    @property
    def total_dim(self) -> int:
        return sum(s.dim for s in self.specs)

    @property
    def dims(self) -> Tuple[int, ...]:
        return tuple(s.dim for s in self.specs)

    def __getitem__(self, name: str) -> FeatureSpec:
        for s in self.specs:
            if s.name == name:
                return s
        raise KeyError(name)

    def __contains__(self, name: str) -> bool:
        return any(s.name == name for s in self.specs)

    def subset(self, names) -> "FeatureSchema":
        """Schema over a feature subset (offsets recomputed)."""
        wanted = set(names)
        specs = [s for s in self.specs if s.name in wanted]
        return _with_offsets(specs)


def _with_offsets(specs: List[FeatureSpec]) -> FeatureSchema:
    out = []
    offset = 0
    for s in sorted(specs, key=lambda s: s.name):
        out.append(dataclasses.replace(s, offset=offset))
        offset += s.dim
    return FeatureSchema(specs=tuple(out))


def build_schema(cfg: Config, names=None) -> FeatureSchema:
    """Build the :class:`FeatureSchema` for ``names`` (default: user|item set).

    The default feature set matches the reference ranking models, which use
    ``user_feature_names | item_feature_names`` (``deep/model.py:42``).
    """
    f = cfg.features
    if names is None:
        names = sorted(set(f.user_feature_names) | set(f.item_feature_names))
    emb = cfg.embeddings
    sparse, dense, array = set(f.sparse_feature_names), set(f.dense_feature_names), set(f.array_feature_names)
    specs: List[FeatureSpec] = []
    for name in names:
        if name in dense:
            specs.append(FeatureSpec(name=name, kind=DENSE, table="", dim=DENSE_FEATURE_DIM, vocab=0))
        elif name in sparse or name in array:
            table = emb.share_emb_table_features.get(name, name)
            phys, id_off, vocab = table, 0, int(emb.embedding_table_size[table])
            member_vocab = 0
            packed = arena_layout(cfg).get(table)
            if packed is not None:
                member_vocab = vocab          # logical bound for id clamping
                phys, id_off, vocab = packed
            specs.append(
                FeatureSpec(
                    name=name,
                    kind=ARRAY if name in array else SPARSE,
                    table=phys,
                    dim=int(emb.embedding_size[table]),
                    vocab=vocab,
                    max_length=int(f.array_max_length.get(name, 0)),
                    id_offset=id_off,
                    member_vocab=member_vocab,
                )
            )
        else:
            raise ValueError(f"Feature '{name}' is not declared sparse/dense/array in config.")
    return _with_offsets(specs)


def _logical_table_specs(cfg: Config) -> Dict[str, Tuple[int, int]]:
    f, emb = cfg.features, cfg.embeddings
    tables: Dict[str, Tuple[int, int]] = {}
    for name in sorted(set(f.sparse_feature_names) | set(f.array_feature_names)):
        table = emb.share_emb_table_features.get(name, name)
        if table in tables:
            continue
        tables[table] = (int(emb.embedding_table_size[table]), int(emb.embedding_size[table]))
    return tables


def arena_layout(cfg: Config) -> Dict[str, Tuple[str, int, int]]:
    """With ``embeddings.arena_tables``: logical table -> (physical arena
    name, id offset, arena vocab) for every packed table.

    Same-dim LARGE tables (vocab >= ARENA_MIN_VOCAB) pack into one
    ``arena_d<D>`` parameter. Row 0 stays the shared padding row; member i
    (sorted by name) occupies rows ``[off_i + 1, off_i + vocab_i)`` with
    ``off_i = sum(vocab_j - 1 for j < i)``, so the logical->arena mapping
    is ``id + off_i`` for real ids and identity for padding.

    Tables backing ARRAY features are excluded from packing, as in the JAX
    package (there their B*L touched slots take a full-table update route
    whose cost scales with the packed vocab), so parameters convert one to
    one: ``arena_tables: true`` leaves sequence configs untouched.
    """
    if not cfg.embeddings.arena_tables:
        return {}
    logical = _logical_table_specs(cfg)
    emb = cfg.embeddings
    array_tables = {emb.share_emb_table_features.get(f, f)
                    for f in cfg.features.array_feature_names}
    by_dim: Dict[int, List[str]] = {}
    for name, (vocab, dim) in sorted(logical.items()):
        if vocab >= ARENA_MIN_VOCAB and name not in array_tables:
            by_dim.setdefault(dim, []).append(name)
    out: Dict[str, Tuple[str, int, int]] = {}
    for dim, members in by_dim.items():
        if len(members) < 2:
            continue                       # nothing to merge
        total = 1 + sum(logical[m][0] - 1 for m in members)
        off = 0
        for m in members:
            out[m] = (f"arena_d{dim}", off, total)
            off += logical[m][0] - 1
    return out


def table_specs(cfg: Config) -> Dict[str, Tuple[int, int]]:
    """Unique PHYSICAL embedding tables -> (vocab, dim), after
    share-aliasing and (optionally) arena packing.

    Mirrors ``BaseModel._build_embedding_tables`` (``base_model.py:141-166``):
    tables exist for sparse ∪ array features, shared tables created once.
    """
    logical = _logical_table_specs(cfg)
    arena = arena_layout(cfg)
    tables: Dict[str, Tuple[int, int]] = {}
    for name, (vocab, dim) in logical.items():
        if name in arena:
            aname, _, avocab = arena[name]
            tables[aname] = (avocab, dim)
        else:
            tables[name] = (vocab, dim)
    return tables
