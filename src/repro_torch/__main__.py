"""``python -m repro_torch <command>``. The only command is ``run``, the
experiment dispatcher (see ``repro_torch.run``)."""
import sys

from repro_torch.run.cli import main

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
