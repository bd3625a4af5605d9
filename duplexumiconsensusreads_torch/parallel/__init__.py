"""Bucket-axis dispatch helpers. One device only so far: the per-GPU
bucket-block dispatch of the JAX package's mesh is not ported."""
