"""Tensor operations of the port: encodings, reweighting, frequencies,
scores, Hamiltonians, the LBFGS engine, the pseudolikelihood and
mean-field fits, and the compare stage's minimum-atom distances."""
