"""Shared host-side helpers of the port (bucketing, device resolution)."""
