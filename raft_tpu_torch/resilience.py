"""The sweeps' bounded non-convergence retry policy (the port's copy of
``SolveRetryPolicy`` from ``raft_tpu/resilience.py``)."""

import dataclasses


@dataclasses.dataclass(frozen=True)
class SolveRetryPolicy:
    """One extra solve of the affected lanes with ``iter_mult x nIter``
    iterations and under-relaxation ``relax`` (0.4 against the
    reference's 0.8), adopted per lane only where the retry converges, so
    lanes healthy on the first pass keep their bits."""

    max_retries: int = 1
    iter_mult: float = 2.0
    relax: float = 0.4

    @property
    def enabled(self):
        return self.max_retries > 0

    @classmethod
    def from_flag(cls, retry_nonconverged):
        """A policy from the sweeps' ``retry_nonconverged=`` argument (a
        bool or a policy)."""
        if isinstance(retry_nonconverged, cls):
            return retry_nonconverged
        return cls(max_retries=1 if retry_nonconverged else 0)

    def escalate(self, nIter):
        """(nIter, relax) of the retry solve."""
        return int(round(self.iter_mult * nIter)), self.relax
