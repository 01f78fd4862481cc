"""The dense decoder model of the port and its layers."""
