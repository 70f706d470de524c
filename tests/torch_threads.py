"""One intra-op CPU thread for torch in every test process of the port.

The port's tests run many small tensor ops (layers at smoke widths, plain
kernels on a few blocks), for which torch's OpenMP pool costs more than it
gives: alone on an 8-core CPU host the phase-M rehearsal took 70.5 s at 8
threads and 26.3 s at 1.  Under `pytest -n 6` six workers of 8 threads each
oversubscribe the cores further.  Every `tests/test_torch_*.py` imports this
module, so
each worker that collects them (xdist collects every file in every worker)
runs torch on one thread; `OMP_NUM_THREADS` carries the same to the
processes that the tests start (spawned ranks, launchers), unless the
caller set it.  Results do not depend on it: each comparison runs both of
its sides in the same process, or holds them to a tolerance.
"""

import os

import torch

os.environ.setdefault("OMP_NUM_THREADS", "1")
torch.set_num_threads(1)
