#!/usr/bin/env python3
"""readings.py with the production fit's faults (tests/faults_production.py)
beside faults.py's, for --fault:

    python3 bench_port/readings_production.py --workload <cell> \
        --seconds <s> [readings.py's options]
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench_port import readings  # noqa: E402
from bench_port.tests import faults, faults_production  # noqa: E402

if __name__ == "__main__":
    faults.FAULTS.update(faults_production.FAULTS)
    sys.exit(readings.main())
