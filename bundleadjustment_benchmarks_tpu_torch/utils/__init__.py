"""Statistics, logger, checkpoints and problem generators."""
