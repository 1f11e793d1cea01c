"""Path constants (reference config/config.py:6-8 parity), a copy of the
JAX package's ``config.py``: the defaults of the train and evaluation CLIs'
``--data_root``, ``--data_dir`` and ``--jsonl_data`` (the JAX scripts' own
literals, unless the environment overrides them)."""

import os

DATA_ROOT = os.environ.get("WCB_DATA_ROOT", "")
DATA_DIR = os.environ.get("WCB_DATA_DIR", "data/medical-united-syn-med-test")
JSONL_DATA = os.environ.get("WCB_JSONL_DATA", "data/medical-united-syn-med-test-jsonl")
