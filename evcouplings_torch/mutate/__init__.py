"""Mutation-effect (EVmutation) calculations and the mutate stage."""
