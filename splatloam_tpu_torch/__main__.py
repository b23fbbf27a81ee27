"""`python -m splatloam_tpu_torch` entry point (also the supervised child
of ``slam --supervise``)."""
from .cli import main

if __name__ == "__main__":
    raise SystemExit(main())
