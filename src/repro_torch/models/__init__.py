"""Lane-batched model: every parameter carries a leading population axis K."""
