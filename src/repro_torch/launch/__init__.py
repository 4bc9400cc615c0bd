"""Entry points of the port: batched serving (`serve`), training on one
device (`train`) and the warm broadcast-plan service (`planserver`)."""
