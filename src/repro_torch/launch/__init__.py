"""Entry points of the port: batched serving (`serve`) and the warm
broadcast-plan service (`planserver`)."""
