#!/bin/bash
# The full-scale quality campaign of the PyTorch port on one card: the
# reference's scoreboard rows for each seed given (the seeds' runs side by
# side, --jobs each), then each seed's cascades over its DSSM's best epoch,
# then (--itemcf) the ItemCF baseline on the same data.
#
#   bash scripts/fullscale_campaign_torch.sh [options] <out dir> [seed ...]   # seeds: 42 7
#
#   --models LIST        the rows (default: the nine rows of the base scoreboard)
#   --model-epochs MAP   NAME=N,... over --epochs 6 / --shallow-epochs 16 /
#                        --dssm-epochs 40 (default: dcn@v2=16)
#   --cascades LIST      TAG:EPOCH,... rankers of the cascades, each with its
#                        epoch: newest, best (the row's best epoch) or a number;
#                        the recall is the seed's dssm@aug+logq+ns8 at its best
#                        epoch, which --models must hold (default: dcn:newest;
#                        "" for none)
#   --jobs N             runs at once for each seed (default: 4)
#   --itemcf             also run `itemcf` (host) once on the campaign's data
#
# <out dir> gets rankers_seed<S>.json, cascade_<tag>_seed<S>.json, seed<S>/
# (the val logs and each run's metrics.jsonl), itemcf.json and the logs; the
# data and the checkpoints go to $FULLSCALE_WORKDIR (default /tmp/fullscale).
set -u
cd "$(dirname "$0")/.."
MODELS=lr,fm,deepfm,dcn@v2,deep,widedeep,dcn,attention,dssm@aug+logq+ns8
MODEL_EPOCHS=dcn@v2=16
CASCADES=dcn:newest
JOBS=4
ITEMCF=0
while [ $# -gt 0 ]; do
  case $1 in
    --models) MODELS=$2; shift 2 ;;
    --model-epochs) MODEL_EPOCHS=$2; shift 2 ;;
    --cascades) CASCADES=$2; shift 2 ;;
    --jobs) JOBS=$2; shift 2 ;;
    --itemcf) ITEMCF=1; shift ;;
    --*) echo "unknown option $1" >&2; exit 2 ;;
    *) break ;;
  esac
done
OUT=$1; shift
SEEDS=${*:-42 7}
W=${FULLSCALE_WORKDIR:-/tmp/fullscale}
RECALL=dssm_aug+logq+ns8
mkdir -p "$OUT"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
# one build before the parallel runs, which would otherwise each run nvcc
python -c 'from news_recsys_tpu_torch.ops import _build; print(_build.build())' || exit 1
SECONDS=0
python scripts/fullscale_rankers_torch.py --prepare --workdir "$W" --models "" \
    > "$OUT/prepare.log" 2>&1 || { tail -20 "$OUT/prepare.log"; exit 1; }
echo "prepare $SECONDS s"
SECONDS=0
for seed in $SEEDS; do
  python scripts/fullscale_rankers_torch.py --config "$W/base.yaml" --workdir "$W/seed$seed" \
      --models "$MODELS" --epochs 6 --shallow-epochs 16 --dssm-epochs 40 \
      --model-epochs "$MODEL_EPOCHS" --jobs "$JOBS" --seed "$seed" \
      --out "$OUT/rankers_seed$seed.json" --val-logs "$OUT/seed$seed" \
      > "$OUT/runs_seed$seed.log" 2>&1 &
done
rc=0
for job in $(jobs -p); do wait "$job" || rc=1; done
echo "campaign $SECONDS s, rc=$rc"

# best_epoch <rankers artifact> <tag>: the row's best epoch
best_epoch() {
  python -c "import json, sys; a = json.load(open(sys.argv[1])); \
print([r for r in a['results'] if r['model'] == sys.argv[2]][0]['best_epoch'])" "$1" "$2"
}
for seed in $SEEDS; do
  grep -v INFO "$OUT/runs_seed$seed.log" | tail -12
  mkdir -p "$OUT/seed$seed"
  for d in "$W/seed$seed"/exp_*; do
    [ -f "$d/metrics.jsonl" ] && \
        cp "$d/metrics.jsonl" "$OUT/seed$seed/$(basename "$d")_metrics.jsonl"
    # the update route each large table took (training/sparse_step.py)
    grep -h " route at " "$d/train_process.log" 2>/dev/null | sed "s|^|$(basename "$d"): |"
  done > "$OUT/seed$seed/routes.log"
  [ -f "$OUT/rankers_seed$seed.json" ] || { rc=1; continue; }
  for spec in ${CASCADES//,/ }; do
    tag=${spec%%:*} epoch=${spec#*:}
    recall=$(best_epoch "$OUT/rankers_seed$seed.json" $RECALL) || { rc=1; continue; }
    if [ "$epoch" = best ]; then
      epoch=$(best_epoch "$OUT/rankers_seed$seed.json" "$tag") || { rc=1; continue; }
    fi
    ckpt="$W/seed$seed/exp_$tag"
    [ "$epoch" = newest ] || ckpt="$ckpt/ckpts/epoch_$(printf %03d "$epoch").pt"
    SECONDS=0
    python scripts/cascade_eval_torch.py --recall-cfg "$W/seed$seed/$RECALL.yaml" \
        --recall-ckpt "$W/seed$seed/exp_$RECALL/ckpts/epoch_$(printf %03d "$recall").pt" \
        --ranker-cfg "$W/seed$seed/$tag.yaml" --ranker-ckpt "$ckpt" \
        --out "$OUT/cascade_${tag}_seed$seed.json" > "$OUT/cascade_${tag}_seed$seed.log" 2>&1 \
        || rc=1
    echo "cascade $tag:$epoch seed $seed (recall epoch $recall): $SECONDS s"
    tail -4 "$OUT/cascade_${tag}_seed$seed.log"
  done
done
if [ "$ITEMCF" = 1 ]; then
  SECONDS=0
  python -m news_recsys_tpu_torch itemcf -c "$W/base.yaml" --max-queries 0 \
      > "$OUT/itemcf.log" 2>&1 || rc=1
  python -c "import json, sys; sys.path.insert(0, '.')
from scripts.fullscale_rankers_torch import card
m = json.load(open(sys.argv[1]))
m = {'device': card('cuda'), 'host': 'ItemCF fits and recalls on the host (numpy)',
     'command': 'python -m news_recsys_tpu_torch itemcf -c <workdir>/base.yaml --max-queries 0',
     **m}
json.dump(m, open(sys.argv[2], 'w'), indent=2)
print(json.dumps(m))" "$W/tmp/itemcf/metrics.json" "$OUT/itemcf.json" || rc=1
  echo "itemcf $SECONDS s"
fi
exit $rc
