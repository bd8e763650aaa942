"""The optimizer and learning-rate schedules."""
