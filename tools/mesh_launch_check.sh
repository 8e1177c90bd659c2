#!/usr/bin/env bash
# The serving launcher on one card and on (data, model) meshes of 4 cards
# under torchrun, run on a machine with 4 cards from the repo's root:
#
#     bash tools/mesh_launch_check.sh [MESH ...]     # default: 2,2 1,4 4,1
#
# Each mesh's streams (rank 0's "stream ID: ..." lines) must equal the
# one-process launcher's; each run's "served" line gives its wall time.
# Outputs land in chiprun_out/mesh_launch/.  Exit status 1 if any mesh
# fails or its streams differ.
set -u
cd "$(dirname "$0")/.."
export PYTHONPATH=src
OUT=chiprun_out/mesh_launch
mkdir -p "$OUT"
ARGS="-m repro_torch.launch.serve --requests 4 --max-context 16384 --max-batch 4
      --fused-decode --sparse-prefill --new-tokens 8 --prefix-len 2048
      --prefill-chunk 512 --streams"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python3 $ARGS > "$OUT/one.txt" 2>&1 || { tail -20 "$OUT/one.txt"; exit 1; }
grep "^served" "$OUT/one.txt"
status=0
for M in "${@:-2,2 1,4 4,1}"; do
  for m in $M; do
    torchrun --standalone --nproc-per-node 4 $ARGS --mesh "$m" > "$OUT/mesh_$m.txt" 2>&1
    rc=$?
    if [ $rc -eq 0 ] && cmp -s <(grep "^stream" "$OUT/one.txt") <(grep "^stream" "$OUT/mesh_$m.txt"); then
      echo "mesh $m: streams equal one process's; $(grep '^served' "$OUT/mesh_$m.txt")"
    else
      echo "mesh $m: exit $rc or streams differ (see $OUT/mesh_$m.txt)"
      status=1
    fi
  done
done
exit $status
