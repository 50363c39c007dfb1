"""``python -m deepgrp_tpu_torch`` entry point.

The ``--threads/-t`` flag is pre-scanned from ``sys.argv`` and exported as
``OMP_NUM_THREADS`` before torch is imported (``__main__.py`` of the JAX
package): OpenMP pools size themselves when the libraries load, so setting
the variable later would bound only the pools created after it.  ``cli.main``
then sets torch's own thread count too (the console script starts there).
"""

import os
import sys


def _prescan_threads(argv) -> None:
    if "OMP_NUM_THREADS" in os.environ:
        return
    for i, arg in enumerate(argv):
        if arg in ("-t", "--threads") and i + 1 < len(argv):
            value = argv[i + 1]
        elif arg.startswith(("--threads=", "-t=")):
            value = arg.split("=", 1)[1]
        else:
            continue
        if value.isdigit() and int(value) > 0:
            os.environ["OMP_NUM_THREADS"] = value
        return


if __name__ == "__main__":
    _prescan_threads(sys.argv[1:])
    from deepgrp_tpu_torch.cli import main

    main()
