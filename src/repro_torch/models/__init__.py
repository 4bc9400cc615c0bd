"""The port's language models (the ``ssm`` family so far)."""
