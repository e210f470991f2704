"""The yardstick: peaks of the card and the least work of kernel ops and whole steps."""
