"""Training: optimizer groups and schedules, the coarse trainer."""
