"""The training runtime on one device: the train step and the supervisor,
ported from ``repro.runtime``."""
