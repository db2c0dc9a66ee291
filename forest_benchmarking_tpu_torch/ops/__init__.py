"""Batched operator tools on torch tensors (ported subset; see ROADMAP.md)."""
