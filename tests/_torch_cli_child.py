"""Child process of tests/test_torch_multihost_e2e.py: one torch thread, then
the port's command line ``python -m <module>`` with the rest of argv, e.g.

    python tests/_torch_cli_child.py probunet_torch.train --device cpu [flags...]

The process group, if any, comes up from the environment inside the command
line, as it does for a user's launch."""

import os
import runpy
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

torch.set_num_threads(1)
module = sys.argv[1]
sys.argv = [module] + sys.argv[2:]
runpy.run_module(module, run_name="__main__", alter_sys=True)
