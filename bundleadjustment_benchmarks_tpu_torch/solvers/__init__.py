"""Schur-complement damped solves and the backtracking LM driver."""
