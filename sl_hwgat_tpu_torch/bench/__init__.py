"""The port's kernel bench: ``kernel`` measures one implementation of the
attention or one decomposition probe on the card and prints one JSON line;
``run`` starts it in child processes and prints the headline metric."""
