"""SU3_Bench: layout codec, kernel registry, execution plan and engine."""
