"""The training runtime, ported from ``repro.runtime``: the train and serve
steps with their sharding helpers, the logical-axis rules, the supervisor,
gradient compression, and the dry-run's cost accounting."""
