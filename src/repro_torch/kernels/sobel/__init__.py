"""3x3 Sobel gradient magnitude, the paper's benchmark app 2."""
