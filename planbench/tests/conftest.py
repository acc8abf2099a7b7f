"""The benchmark's own tests: `python -m pytest planbench/tests -q` from the
repository's root (the card's tests, marked gpu, skip without one)."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
