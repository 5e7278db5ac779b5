"""Input data of the port's train path: synthetic LM batches."""
