"""The benchmark's own tests put ``dspbench/`` and the checkout's root on
the import path, as ``python3 dspbench/run.py`` has them."""

import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for p in (HERE, os.path.dirname(HERE), os.path.join(HERE, "tests")):
    if p not in sys.path:
        sys.path.insert(0, p)
