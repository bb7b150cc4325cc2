#!/usr/bin/env bash
# CI gate: build + functional test + package as one chained pipeline —
# the equivalent of the reference's Jenkins scripts
# (/root/reference/scripts/jenkins/tool-leon-build-debian7-64bits-gcc-4.7.sh:48-96,
# which chain cmake build -> simple_test.sh round-trip -> cpack package).
#
# Usage: scripts/ci.sh [--fast]
#   --fast: run the round-trip smoke subset instead of the whole suite.
set -euo pipefail
cd "$(dirname "$0")/.."

echo "== [1/4] native build (g++ host kernels)"
JAX_PLATFORMS=cpu python - <<'EOF'
from leon_tpu.native import get_lib
lib = get_lib()
assert lib is not None, "native toolchain build failed"
print("native kernels built + loaded")
EOF

echo "== [2/4] functional round-trip (reference oracle: simple_test.sh)"
tmp=$(mktemp -d)
trap 'rm -rf "$tmp"' EXIT
python - "$tmp/toy.fasta" <<'EOF'
import sys, numpy as np
rng = np.random.default_rng(7)
B = np.frombuffer(b"ACGT", dtype=np.uint8)
contig = rng.integers(0, 4, 5000, dtype=np.uint8)
with open(sys.argv[1], "wb") as f:
    for i in range(200):
        s = int(rng.integers(0, 4900))
        f.write(b">read%d\n%s\n" % (i, B[contig[s:s+100]].tobytes()))
EOF
JAX_PLATFORMS=cpu python -m leon_tpu.cli -file "$tmp/toy.fasta" -c -test-file -verbose 0

echo "== [3/4] test suite"
if [[ "${1:-}" == "--fast" ]]; then
  JAX_PLATFORMS=cpu python -m pytest tests/test_roundtrip.py -x -q
else
  JAX_PLATFORMS=cpu python -m pytest tests/ -x -q
fi

echo "== [4/4] package"
bash scripts/package.sh
echo "CI gate: ALL GREEN"
