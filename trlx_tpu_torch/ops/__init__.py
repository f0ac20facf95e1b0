"""Numeric primitives and the hand-written attention kernels."""
