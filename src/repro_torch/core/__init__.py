"""The static connected-components engines and their round machinery."""
