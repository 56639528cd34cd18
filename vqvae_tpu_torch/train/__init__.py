"""Training of the PyTorch port: schedules, optimizer, state, steps, Trainer."""
