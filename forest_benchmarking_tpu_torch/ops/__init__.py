"""Batched operator tools on torch tensors: every module of the JAX
package's ``ops/`` (its ``*_sharded`` entry points wait; see ROADMAP.md)."""
