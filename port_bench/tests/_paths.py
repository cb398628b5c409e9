"""Puts the harness and the repository root on sys.path for the tests."""

import os
import sys

HARNESS = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HARNESS)
for p in (HARNESS, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)
