"""Potts-model containers and the plmc-replacement fitter."""
