"""One intra-op torch thread in each test process; every port test module
imports this module for that effect.

The suite runs in 6 xdist worker processes (`-p xdist -n 6`) on an
8-core CPU.  With torch's default of one intra-op thread a core, each
worker's parallel regions wait at their barriers for threads that the
other workers' processes hold: a chunk test that takes 2 s alone took
55-72 s in the suite.  The port's tests run a few dozen to a few thousand
worlds, where one thread is as fast alone (1.6 s for that test).  The
suite passes with one thread and with torch's default."""

import torch

torch.set_num_threads(1)
