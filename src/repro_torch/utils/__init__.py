"""Tree utilities shared by the port's modules."""
