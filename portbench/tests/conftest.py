"""Make the benchmark's modules (harness, reference) and the repository's
packages importable from these tests."""
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH), str(BENCH.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)
