"""``python -m deepgrp_tpu_torch`` entry point."""

from deepgrp_tpu_torch.cli import main

if __name__ == "__main__":
    main()
