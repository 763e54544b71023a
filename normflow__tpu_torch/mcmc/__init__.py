"""Independence-Metropolis and blocked MCMC samplers."""

from .metropolis import (BlockedMCMCSampler, MCMCHistory, MCMCSampler,
                         Metropolis, ModifiedMetropolis, accept_scan,
                         estimate_accept_rate)

__all__ = [
    "MCMCSampler", "BlockedMCMCSampler", "MCMCHistory", "Metropolis",
    "ModifiedMetropolis", "accept_scan", "estimate_accept_rate",
]
