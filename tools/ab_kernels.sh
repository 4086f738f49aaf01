#!/usr/bin/env bash
# Compare this checkout's production (b3) kernels with another commit's.
#
#   mkdir -p build/parent && git archive <commit> | tar -x -C build/parent
#   tools/ab_kernels.sh build/parent build/ab      # on a machine with the card
#
# From the root of this checkout: each tree's own chip_smoke.py prints the
# sha256 of K1-K3, K7, K8 (--edge-hash), K5, K6 (--layer-hash) and K4
# (--cap-hash) on the same fixed inputs; tools/compare_sass.py compares the
# machine code of the two b3 libraries; then each tree's bench_torch.py in
# turns (other, this, this, other: graphed ms/step and kernels per step of
# the lone Chignolin step).  Everything goes to OUT_DIR; the last lines say
# whether the hashes and the code are equal.
set -euo pipefail
other=$(cd "$1" && pwd)
mkdir -p "$2"
out=$(cd "$2" && pwd)
here=$(pwd)

hashes() {   # tree label
  (cd "$1" && for flag in --edge-hash --layer-hash --cap-hash; do
     python3 chip_smoke.py "$flag"
   done) > "$out/hashes_$2.log" 2>&1
  grep -E "sha256" "$out/hashes_$2.log" | sed -E 's/ in [0-9.]+ s//' > "$out/sha_$2.txt"
}

hashes "$other" other
hashes "$here" this
lib_other=$(ls -t "$other"/build/ai2bmd_torch/libai2bmd_kernels_*.so | head -n 1)
lib_this=$(ls -t "$here"/build/ai2bmd_torch/libai2bmd_kernels_b3_*.so | head -n 1)
python3 "$here/tools/compare_sass.py" "$lib_other" "$lib_this" > "$out/sass.txt" || true

for run in other this this other; do
  tree=$other
  [ "$run" = this ] && tree=$here
  (cd "$tree" && python3 bench_torch.py) > "$out/bench_$run.log" 2>&1
  tail -n 1 "$out/bench_$run.log" >> "$out/bench_$run.jsonl"
done

nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
if diff "$out/sha_other.txt" "$out/sha_this.txt" > "$out/sha.diff"; then
  echo "hashes: equal ($(wc -l < "$out/sha_this.txt") lines)"
else
  echo "hashes: DIFFER"; cat "$out/sha.diff"
fi
cat "$out/sass.txt"
for run in other this; do
  echo "bench_torch.py, $run tree:"
  cat "$out/bench_$run.jsonl"
done
