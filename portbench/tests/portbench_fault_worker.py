"""A rank of ``portbench/worker.py`` with a fault planted under the timed
path: ``python portbench_fault_worker.py FAULT <worker flags>``, started
through the port's launcher by test_portbench_faults.py."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import portbench_tiny  # noqa: E402
from portbench import worker  # noqa: E402

if __name__ == "__main__":
    sys.exit(worker.main(sys.argv[2:],
                         hooks=portbench_tiny.FAULTS[sys.argv[1]]))
