"""Training engine of the port: losses, optimizer and schedule, train/eval
steps and the epoch loops."""
