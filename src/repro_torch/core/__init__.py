"""GS core, adapters, PEFT engine and the serving runtime."""
