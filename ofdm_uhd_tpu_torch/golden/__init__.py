"""NumPy helpers the port's host tables are built from (copies of the
table-building parts of the reference's golden/ package)."""
