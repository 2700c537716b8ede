"""Serving plane: tool database, learned-stage snapshots and the gateway."""
