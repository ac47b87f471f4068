"""Batched serving: greedy decode and the continuous-batching server."""
