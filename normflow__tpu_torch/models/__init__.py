"""Flows, nets, masks, priors and actions of the flagship sampling path."""
