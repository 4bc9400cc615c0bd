"""Entry points of the port: batched serving (`serve`)."""
