#!/usr/bin/env python3
"""calibrate.py with the planted faults of the cell's own driver:

    python3 perfbench/calibrate_driver.py --workload <name> --seeds 1,2 \
        --fault <name> [the other options of calibrate.py]

--fault names an entry of the driver module's FAULTS
(drivers/render_m360.py, drivers/train_m360.py), which perfbench/faults.py
does not hold; a name both hold is the driver's. Everything else is
calibrate.py's.
"""

import importlib
import os
import sys

if __name__ == "__main__":
    ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path[0:1] = [ROOT, os.path.join(ROOT, "src")]

from perfbench import calibrate, faults, harness  # noqa: E402


def main() -> int:
    cell = harness.Cell.load(sys.argv[sys.argv.index("--workload") + 1])
    driver = cell.traffic["driver"]
    own = importlib.import_module(f"perfbench.drivers.{driver}").FAULTS
    faults.FAULTS[driver] = {**faults.FAULTS.get(driver, {}), **own}
    return calibrate.main()


if __name__ == "__main__":
    sys.exit(main())
