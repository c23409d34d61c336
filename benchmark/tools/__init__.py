"""One-off measurements on the card: the readings that the cells' limits
are set from."""
