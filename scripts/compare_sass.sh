#!/usr/bin/env bash
# Whether two checkouts compile a kernel source to the same machine code:
# builds csrc/<name>.cu of each checkout with the package's nvcc flags
# (repro_torch.kernels._build) and diffs `cuobjdump -sass` of the two
# libraries instruction by instruction (addresses and encodings dropped):
#
#     git archive PARENT | tar -x -C build/parent
#     scripts/compare_sass.sh build/parent slot_extract slot_extract_grouped
#
# Prints, per source, the instruction lines of each checkout and how many
# differ; exits 1 when any differ.  Needs nvcc and cuobjdump (the CUDA
# toolkit under $CUDA_HOME, default /usr/local/cuda).
set -euo pipefail
other=$1
shift
here=$(cd "$(dirname "$0")/.." && pwd)
cuobjdump=${CUDA_HOME:-/usr/local/cuda}/bin/cuobjdump

sass() {  # checkout, source name -> its instruction lines
  local lib
  lib=$(cd "$1" && PYTHONPATH=src python3 -c "
import sys
from repro_torch.kernels import _build
_build.build_all([sys.argv[1]])
print(_build._target(sys.argv[1]))" "$2")
  "$cuobjdump" -sass "$lib" | grep -E '^\s+/\*[0-9a-f]{4}\*/' |
    sed -E 's@/\*[0-9a-f]{4}\*/@@; s@ */\* 0x[0-9a-f]+ \*/@@'
}

status=0
for name in "$@"; do
  a=$(sass "$other" "$name")
  b=$(sass "$here" "$name")
  n=$(diff <(echo "$a") <(echo "$b") | grep -c '^[<>]' || true)
  echo "$name: $(echo "$a" | wc -l) instruction lines in $other," \
    "$(echo "$b" | wc -l) here, $n differing"
  [ "$n" -eq 0 ] || status=1
done
exit $status
