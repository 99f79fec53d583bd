"""Operation and byte counts of the work a cell does, from its
configuration and traffic alone, and the card's published peaks."""
