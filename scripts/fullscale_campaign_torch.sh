#!/bin/bash
# The full-scale quality campaign of the PyTorch port on one card: the
# reference's scoreboard rows for each seed given (the seeds' runs side by
# side, --jobs 4 each), then each seed's cascade over its DSSM's best epoch.
#
#   bash scripts/fullscale_campaign_torch.sh <out dir> [seed ...]   # default: 42 7
#
# <out dir> gets rankers_seed<S>.json, cascade_seed<S>.json, seed<S>/ (the
# val logs and each run's metrics.jsonl) and the logs; the data and the
# checkpoints go to $FULLSCALE_WORKDIR (default /tmp/fullscale).
set -u
cd "$(dirname "$0")/.."
OUT=$1; shift
SEEDS=${*:-42 7}
W=${FULLSCALE_WORKDIR:-/tmp/fullscale}
MODELS=lr,fm,deepfm,dcn@v2,deep,widedeep,dcn,attention,dssm@aug+logq+ns8
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
      --models $MODELS --epochs 6 --shallow-epochs 16 --dssm-epochs 40 \
      --model-epochs dcn@v2=16 --jobs 4 --seed "$seed" --out "$OUT/rankers_seed$seed.json" \
      --val-logs "$OUT/seed$seed" > "$OUT/runs_seed$seed.log" 2>&1 &
done
rc=0
for job in $(jobs -p); do wait "$job" || rc=1; done
echo "campaign $SECONDS s, rc=$rc"
for seed in $SEEDS; do
  grep -v INFO "$OUT/runs_seed$seed.log" | tail -10
  [ -f "$OUT/rankers_seed$seed.json" ] || { rc=1; continue; }
  best=$(python -c "import json, sys; a = json.load(open(sys.argv[1])); \
print([r for r in a['results'] if r['model'].startswith('dssm')][0]['best_epoch'])" \
      "$OUT/rankers_seed$seed.json")
  python scripts/cascade_eval_torch.py --recall-cfg "$W/seed$seed/dssm_aug+logq+ns8.yaml" \
      --recall-ckpt "$W/seed$seed/exp_dssm_aug+logq+ns8/ckpts/epoch_$(printf %03d "$best").pt" \
      --ranker-cfg "$W/seed$seed/dcn.yaml" --ranker-ckpt "$W/seed$seed/exp_dcn" \
      --out "$OUT/cascade_seed$seed.json" > "$OUT/cascade_seed$seed.log" 2>&1 || rc=1
  tail -4 "$OUT/cascade_seed$seed.log"
  for d in "$W/seed$seed"/exp_*; do
    cp "$d/metrics.jsonl" "$OUT/seed$seed/$(basename "$d")_metrics.jsonl"
  done
done
exit $rc
