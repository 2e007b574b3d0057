"""``python -m relayrl_tpu_torch.analysis`` — the torchlint CLI entry point."""

import sys

from relayrl_tpu_torch.analysis.cli import main

if __name__ == "__main__":
    sys.exit(main())
