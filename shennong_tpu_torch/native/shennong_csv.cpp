// Threaded CSV writer for the host IO runtime.
//
// The CSV serializer's cost is float->text formatting (hundreds of
// millions of conversions on a corpus-scale collection); numpy's
// savetxt formats row by row in Python through printf. This writer
// renders with std::to_chars shortest-round-trip form — exact for
// IEEE doubles, several times faster than snprintf, locale-free and
// lock-free — across a pool of threads, each rendering a contiguous
// row range into its own buffer, then writes the file in one pass.
//
// Exposed C API (bound from native/__init__.py):
//   shennong_csv_write(path, header, values, nrows, ncols, nthreads)
//     -> bytes written, or -1 on failure

#include <charconv>
#include <cinttypes>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

// longest shortest-round-trip rendering of a double (sign, 17
// digits, point, exponent)
constexpr int kMaxField = 32;

void render_rows(
        const double* values, int64_t row_begin, int64_t row_end,
        int32_t ncols, std::string* out) {
    out->reserve((row_end - row_begin) * ncols * 12);
    char field[kMaxField];
    for (int64_t row = row_begin; row < row_end; ++row) {
        const double* cell = values + row * ncols;
        for (int32_t col = 0; col < ncols; ++col) {
            const auto result =
                std::to_chars(field, field + sizeof(field) - 1, cell[col]);
            *result.ptr = (col + 1 < ncols) ? ' ' : '\n';
            out->append(field, result.ptr + 1 - field);
        }
    }
}

}  // namespace

extern "C" {

int64_t shennong_csv_write(
        const char* path, const char* header, const double* values,
        int64_t nrows, int32_t ncols, int32_t nthreads) {
    if (nrows < 0 || ncols <= 0)
        return -1;
    if (nthreads < 1)
        nthreads = 1;
    if (nthreads > nrows && nrows > 0)
        nthreads = (int32_t)nrows;

    std::vector<std::string> chunks((size_t)nthreads);
    std::vector<std::thread> workers;
    const int64_t rows_per_thread = (nrows + nthreads - 1) / nthreads;
    for (int32_t t = 0; t < nthreads; ++t) {
        const int64_t begin = (int64_t)t * rows_per_thread;
        const int64_t end =
            begin + rows_per_thread < nrows
                ? begin + rows_per_thread : nrows;
        if (begin >= end)
            break;
        workers.emplace_back(
            render_rows, values, begin, end, ncols, &chunks[(size_t)t]);
    }
    for (auto& worker : workers)
        worker.join();

    FILE* fp = fopen(path, "wb");
    if (!fp)
        return -1;
    int64_t total = 0;
    if (header && header[0]) {
        const size_t len = strlen(header);
        if (fwrite(header, 1, len, fp) != len) {
            fclose(fp);
            return -1;
        }
        total += (int64_t)len;
    }
    for (const std::string& chunk : chunks) {
        if (chunk.empty())
            continue;
        if (fwrite(chunk.data(), 1, chunk.size(), fp) != chunk.size()) {
            fclose(fp);
            return -1;
        }
        total += (int64_t)chunk.size();
    }
    return fclose(fp) == 0 ? total : -1;
}

}  // extern "C"
