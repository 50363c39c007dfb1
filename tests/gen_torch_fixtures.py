"""Write the PyTorch port's ``.npz`` copies of the reference ``.h5`` models.

Usage: ``python tests/gen_torch_fixtures.py`` (needs ``h5py``).  Reads
``tests/fixtures/reference/{gru_att,gru,lstm}.h5`` with the port's own
``load_keras_h5`` and writes ``tests/fixtures/torch/<name>.npz``, which
machines without ``h5py`` can load.  ``tests/test_torch_model.py`` checks
that each ``.npz`` equals its ``.h5`` array for array.
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from deepgrp_tpu_torch.models.keras_io import (load_keras_h5,  # noqa: E402
                                               save_model_npz)

NAMES = ("gru_att", "gru", "lstm")


def main() -> None:
    out_dir = os.path.join(HERE, "fixtures", "torch")
    os.makedirs(out_dir, exist_ok=True)
    for name in NAMES:
        config, params = load_keras_h5(
            os.path.join(HERE, "fixtures", "reference", f"{name}.h5"))
        save_model_npz(os.path.join(out_dir, f"{name}.npz"), config, params)
        print(name, config)


if __name__ == "__main__":
    main()
