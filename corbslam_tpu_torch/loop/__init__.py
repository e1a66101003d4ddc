"""Loop closing."""
