"""The plain reference: each configuration's data generator and the
numpy group-by that works its answers out again from the generated rows.
Standard library and numpy only; nothing of the port."""
