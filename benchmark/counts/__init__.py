"""The frozen yardstick: peak rates and each kernel's operations and bytes."""
