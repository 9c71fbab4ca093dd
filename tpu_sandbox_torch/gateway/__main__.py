"""``python -m tpu_sandbox_torch.gateway`` — the gateway process entrypoint.

(`gateway/server.py` is imported by the package ``__init__``, so running
it via ``-m tpu_sandbox_torch.gateway.server`` would execute it twice under
runpy; this shim is the canonical CLI.)
"""

import sys

from tpu_sandbox_torch.gateway.server import main

if __name__ == "__main__":
    sys.exit(main())
