"""`python -m abpoa_tpu_torch reads.fa [--device cuda|cpu]`."""
import sys

from .cli import main

if __name__ == "__main__":
    try:
        sys.exit(main())
    except RuntimeError as e:
        print(f"Error: {e}", file=sys.stderr)
        sys.exit(1)
