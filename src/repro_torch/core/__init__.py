"""Oracles, backend/device policy and the fusion planner."""
