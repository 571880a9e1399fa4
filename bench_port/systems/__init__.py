"""Systems: one module per kind of configuration (its `system`
key), each driving the port's entry points for that kind of cell."""
