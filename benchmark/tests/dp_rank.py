"""One of the other ranks of a MINI data-parallel train cell
(``train_dp.WORKER`` in ``test_portbench_dp.py``): the MINI dual encoder
registered in this process's zoo, then the driver's rank."""

import sys

from benchmark.drivers import train_dp
from benchmark.tests import mini

if __name__ == "__main__":
    mini.register()
    sys.exit(train_dp.main())
