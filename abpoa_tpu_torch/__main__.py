"""`python -m abpoa_tpu_torch reads.fa [--device cuda|cpu|native]`: a
RuntimeError (no card, a kernel library that cannot be built or loaded)
is one error line and exit code 1."""
import sys

from .cli import main

if __name__ == "__main__":
    try:
        sys.exit(main())
    except RuntimeError as e:
        print(f"Error: {e}", file=sys.stderr)
        sys.exit(1)
