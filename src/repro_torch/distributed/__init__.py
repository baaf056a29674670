"""Step builders of the port: training, prefill and serving steps."""
