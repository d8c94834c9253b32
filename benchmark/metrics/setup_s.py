"""setup_s: from the start of the process to the first measured request:
imports, the card's context, the kernels' builds, the deployment made
from the seed, and the warm-up requests."""


def read(run):
    return run.setup_s
