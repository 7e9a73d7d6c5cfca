"""Signature-compatible shim over the framework's evaluation CLI.

Keeps the reference's public entry point (``src/evaluation_vit.py`` invoked
by ``vit_stn_exp.sh:1``) working unmodified: same flags, same defaults, same
log output location — backed by ``vit_grid_model_tpu``.
"""

import os
import sys

# BLAS thread pinning, as the reference does before heavy imports
# (``evaluation_vit.py:3-5``)
os.environ.setdefault("OMP_NUM_THREADS", "4")
os.environ.setdefault("MKL_NUM_THREADS", "4")
os.environ.setdefault("NUMEXPR_NUM_THREADS", "4")

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from vit_grid_model_tpu.cli.evaluation_vit import main  # noqa: E402

if __name__ == "__main__":
    main()
