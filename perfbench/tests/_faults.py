"""Faults planted in the timed path of a training cell, in the test's
process and, for a cell on several ranks, in every rank's (:func:`rank_command`).

Each fault takes ``setattr`` (pytest's ``monkeypatch.setattr`` in a test,
the builtin in a rank's process)."""

import sys


def state_unchanged(setattr):
    """A step that returns its state unchanged: the optimizer does not update."""
    from probunet_torch.train.state import Optimizer

    setattr(Optimizer, "step", lambda self: False)


def elbo_half(setattr):
    """Half of the batch left out: the loss of the first half, doubled."""
    from probunet_torch.models.prob_unet import ProbabilisticUNet

    orig = ProbabilisticUNet.elbo

    def elbo(self, x, target, beta=None, generator=None, eps=None, shard=(0, 1)):
        h = x.shape[0] // 2
        t, r, k = orig(self, x[:h], target[:h], beta, generator,
                       None if eps is None else eps[:h], shard)
        return 2 * t, 2 * r, 2 * k

    setattr(ProbabilisticUNet, "elbo", elbo)


def no_exchange(setattr):
    """The exchange between ranks left out: each rank keeps its own gradient."""
    from probunet_torch.parallel.mesh import DataParallel

    setattr(DataParallel, "allreduce_grads", lambda self, params, mean: None)


FAULTS = {f.__name__: f for f in (state_unchanged, elbo_half, no_exchange)}


def rank_command(fault: str) -> list:
    """``perfbench.ranks.COMMAND`` with ``fault`` planted before the rank runs."""
    code = ("import sys; sys.path.insert(0, 'perfbench/tests'); import _faults; "
            "_faults.FAULTS[sys.argv[1]](setattr); from perfbench import ranks; "
            "sys.exit(ranks.main(sys.argv[2:]))")
    return [sys.executable, "-c", code, fault]

