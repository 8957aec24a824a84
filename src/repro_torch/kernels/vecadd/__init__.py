"""Vector addition, the paper's benchmark app 3."""
