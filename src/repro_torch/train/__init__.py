"""Loss, train step and population engine."""
