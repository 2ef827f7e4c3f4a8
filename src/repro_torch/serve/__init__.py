"""Serving: raw-row ensemble prediction."""
