"""Core of the port: SDE schedulers, the per-request-seeded rollout and the
frozen condition encoder."""
