"""DAG-FL consensus core of the port: ledger, bank, validation, Algorithms 1 and 2."""
