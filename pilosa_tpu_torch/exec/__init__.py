"""PQL execution."""
