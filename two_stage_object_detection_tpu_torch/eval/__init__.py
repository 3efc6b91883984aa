"""Detection metrics and the evaluation loop."""
