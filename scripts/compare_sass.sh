#!/usr/bin/env bash
# Whether two checkouts compile a kernel source to the same machine code:
# builds csrc/<name>.cu of each checkout with the package's nvcc flags
# (repro_torch.kernels._build) and diffs `cuobjdump -sass` of the two
# libraries instruction by instruction (addresses and encodings dropped),
# function by function:
#
#     git archive PARENT | tar -x -C build/parent
#     scripts/compare_sass.sh build/parent slot_extract slot_extract_grouped
#
# Prints, per source, the instruction lines of each checkout, how many
# differ in the functions both libraries hold, and the functions only one
# of them holds (a kernel a shared header no longer defines, say); exits 1
# when a function both hold differs.  Needs nvcc and cuobjdump (the CUDA
# toolkit under $CUDA_HOME, default /usr/local/cuda).
set -euo pipefail
other=$1
shift
here=$(cd "$(dirname "$0")/.." && pwd)
cuobjdump=${CUDA_HOME:-/usr/local/cuda}/bin/cuobjdump

sass() {  # checkout, source name -> "function<TAB>instruction" lines
  local lib
  lib=$(cd "$1" && PYTHONPATH=src python3 -c "
import sys
from repro_torch.kernels import _build
_build.build_all([sys.argv[1]])
print(_build._target(sys.argv[1]))" "$2")
  "$cuobjdump" -sass "$lib" |
    awk '/Function :/ { fn = $3 } /^[ \t]+\/\*[0-9a-f][0-9a-f][0-9a-f][0-9a-f]\*\// { print fn "\t" $0 }' |
    sed -E 's@/\*[0-9a-f]{4}\*/@@; s@ */\* 0x[0-9a-f]+ \*/@@'
}

status=0
for name in "$@"; do
  a=$(sass "$other" "$name")
  b=$(sass "$here" "$name")
  python3 - "$name" "$other" <(echo "$a") <(echo "$b") <<'PY' || status=1
import difflib, re, sys
name, other, fa, fb = sys.argv[1:]
# an anonymous namespace's mangled name carries a hash of its file
ANON = re.compile(r"\d+_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]{8}")


def by_function(path):
    out = {}
    for line in open(path):
        fn, _, ins = line.rstrip("\n").partition("\t")
        if fn:
            out.setdefault(ANON.sub("(anonymous)", fn), []).append(ins)
    return out

a, b = by_function(fa), by_function(fb)
both = sorted(set(a) & set(b))
n = sum(1 for fn in both
        for d in difflib.ndiff(a[fn], b[fn]) if d[:1] in "+-")
print(f"{name}: {sum(map(len, a.values()))} instruction lines in {other}, "
      f"{sum(map(len, b.values()))} here; {len(both)} functions in both, "
      f"{n} differing lines in them")
for fn in sorted(set(a) ^ set(b)):
    side = other if fn in a else "here"
    print(f"  only {side}: {fn} ({len((a if fn in a else b)[fn])} lines)")
sys.exit(1 if n else 0)
PY
done
exit $status
