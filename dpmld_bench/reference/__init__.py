"""The plain reference and the comparison that decides ``correct``; it
imports nothing of the program."""
