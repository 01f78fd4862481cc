"""Configuration surface, paging and masks of the port."""
