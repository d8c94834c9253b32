"""``python -m blance_tpu_torch.obs.device_check`` — the device-obs gate.

A thin delegate over :func:`blance_tpu_torch.obs.device.main` (flags:
``--check``, ``--device``, ``--trace-out``).  The package ``__init__``
imports ``obs.device`` eagerly, so ``python -m
blance_tpu_torch.obs.device`` would execute the module a SECOND time
under runpy with its own copy of the observatory state; this shim is
imported by nothing, so running it arms the canonical instance — the
same pattern as ``obs/__main__.py``."""

import sys

from .device import main

if __name__ == "__main__":
    sys.exit(main())
