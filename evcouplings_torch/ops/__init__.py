"""Tensor operations of the port: encodings, reweighting, frequencies,
scores, Hamiltonians, the LBFGS engine and the pseudolikelihood fit."""
