"""deepgrp_tpu_torch — DeepGRP repeat annotation in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper (H100).

The PyTorch/CUDA counterpart of the JAX package ``deepgrp_tpu``: module
names mirror that package's, so each module's counterpart is found by its
path.  It imports neither JAX nor ``deepgrp_tpu``.  Entry points run on
``cuda`` unless the caller passes ``device="cpu"`` (``--device cpu`` on the
command line); with the default device and no GPU they raise.
"""

__version__ = "0.1.0"
