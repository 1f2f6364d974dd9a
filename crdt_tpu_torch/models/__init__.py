"""The replica models of the port."""
