"""Train and eval steps, optimizers and the train state."""
