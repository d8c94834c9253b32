"""``python -m blance_tpu_torch.obs`` — the exposition CLI (obs/expo.py).

A thin delegate so the package can be invoked without the 'found in
sys.modules' RuntimeWarning that ``-m blance_tpu_torch.obs.expo``
triggers (the package __init__ imports expo eagerly)."""

import sys

from .expo import main

if __name__ == "__main__":
    sys.exit(main())
