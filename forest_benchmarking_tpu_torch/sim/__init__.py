"""Simulation helpers on torch tensors (ported subset; see ROADMAP.md)."""
