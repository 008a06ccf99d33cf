"""`python -m jax_mapping_torch.analysis` — the lint CLI as a module entry
point, for environments that run the package from a checkout without
installed console scripts. Identical arguments and exit-code contract as
`jax-mapping-torch-lint` (see cli.py)."""

import sys

from jax_mapping_torch.analysis.cli import main

if __name__ == "__main__":
    sys.exit(main())
