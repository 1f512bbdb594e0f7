// Undo the row filters of a PNG image's scanlines (8-bit samples), the host
// half of io/png.py's reader. A plain C entry point, loaded with ctypes; the
// tests hold the reader equal to OpenCV's on every filter.
//
// lines: `height` scanlines of 1 + row_bytes bytes, the filter type then the
// filtered samples. out: `height` rows of row_bytes samples. bpp: samples a
// pixel (the distance to the "left" byte). Returns the first row whose filter
// type does not exist, or -1 when every row was undone.

#include <cstdint>
#include <cstdlib>

extern "C" int va_png_unfilter(const uint8_t* lines, int64_t height,
                               int64_t row_bytes, int64_t bpp, uint8_t* out) {
  const uint8_t* prior = nullptr;  // the row above; zeros above the first
  for (int64_t y = 0; y < height; ++y) {
    const uint8_t* src = lines + y * (row_bytes + 1);
    const uint8_t type = *src++;
    uint8_t* row = out + y * row_bytes;
    for (int64_t x = 0; x < row_bytes; ++x) {
      const int a = x >= bpp ? row[x - bpp] : 0;
      const int b = prior ? prior[x] : 0;
      const int c = prior && x >= bpp ? prior[x - bpp] : 0;
      int pred;
      switch (type) {
        case 0: pred = 0; break;
        case 1: pred = a; break;
        case 2: pred = b; break;
        case 3: pred = (a + b) >> 1; break;
        case 4: {
          const int pa = std::abs(b - c), pb = std::abs(a - c);
          const int pc = std::abs(a + b - 2 * c);
          pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          break;
        }
        default: return static_cast<int>(y);
      }
      row[x] = static_cast<uint8_t>(src[x] + pred);
    }
    prior = row;
  }
  return -1;
}
