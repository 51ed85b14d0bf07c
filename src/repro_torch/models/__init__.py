"""The model stack: the dense GQA transformer family's serving path."""
