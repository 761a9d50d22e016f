#!/usr/bin/env python
"""Regenerate the committed golden-oracle caches (tests/goldens/*.npz).

Runs the scalar NumPy oracle live for every cached golden test — slow by
design (the room configs take ~10 min each); run after any INTENTIONAL
change to renderer semantics, then commit the refreshed .npz files.

    python scripts/regen_goldens.py [SUBSTRING]   # only matching tests
"""

import os
import subprocess
import sys

os.environ["VOXTRACER_LIVE_ORACLE"] = "1"
os.environ["VOXTRACER_WRITE_GOLDENS"] = "1"

tests = [
    "tests/test_golden.py::test_primary_teapot_matches_oracle",
    "tests/test_golden.py::test_whitted_glassbox_matches_oracle",
    "tests/test_golden.py::test_whitted_room_matches_oracle",
    "tests/test_golden.py::test_whitted_roomglass_matches_oracle",
    "tests/test_golden.py::test_primary_monu_matches_oracle",
    "tests/test_golden.py::test_primary_city_matches_oracle",
]
if len(sys.argv) > 1:
    tests = [t for t in tests if sys.argv[1] in t]
sys.exit(subprocess.call([sys.executable, "-m", "pytest", "-q", "-x",
                          *tests]))
