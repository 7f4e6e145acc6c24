// Native data-loader core: JPEG/PNG decode + bilinear resize + normalize,
// multithreaded, C ABI (consumed from Python via ctypes).
//
// TPU-native replacement for the reference's per-sample PIL/torchvision
// decode inside DataLoader workers (edit_dataset.py:135-155,
// train.py:149-151): feeding a v5e-8 at batch 64 × 512² needs decode
// throughput that Python-side PIL can't sustain; this pushes the byte work
// into C++ threads while the Python side stays a thin orchestrator.
//
// Build: g++ -O3 -march=native -shared -fPIC loader.cpp -ljpeg -lpng -o libpdloader.so

#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>

namespace {

struct Image {
    std::vector<uint8_t> rgb;  // H*W*3
    int h = 0, w = 0;
};

struct JpegErr {
    jpeg_error_mgr mgr;
    jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
    auto* err = reinterpret_cast<JpegErr*>(cinfo->err);
    longjmp(err->jb, 1);
}

bool decode_jpeg(FILE* f, Image* out, int target = 0) {
    jpeg_decompress_struct cinfo;
    JpegErr jerr;
    cinfo.err = jpeg_std_error(&jerr.mgr);
    jerr.mgr.error_exit = jpeg_err_exit;
    if (setjmp(jerr.jb)) {
        jpeg_destroy_decompress(&cinfo);
        return false;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_stdio_src(&cinfo, f);
    jpeg_read_header(&cinfo, TRUE);
    cinfo.out_color_space = JCS_RGB;
    if (target > 0) {
        // DCT-domain downscaling: decode at the smallest n/8 scale that
        // still covers the resize target — large wins for big sources.
        int dim = cinfo.image_width < cinfo.image_height ? cinfo.image_width
                                                         : cinfo.image_height;
        int num = 8;
        while (num > 1 && (dim * (num - 1)) / 8 >= target) --num;
        cinfo.scale_num = num;
        cinfo.scale_denom = 8;
    }
    jpeg_start_decompress(&cinfo);
    out->w = cinfo.output_width;
    out->h = cinfo.output_height;
    out->rgb.resize(size_t(out->h) * out->w * 3);
    while (cinfo.output_scanline < cinfo.output_height) {
        JSAMPROW row = out->rgb.data() + size_t(cinfo.output_scanline) * out->w * 3;
        jpeg_read_scanlines(&cinfo, &row, 1);
    }
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return true;
}

bool decode_png(FILE* f, Image* out) {
    png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
    if (!png) return false;
    png_infop info = png_create_info_struct(png);
    if (!info) {
        png_destroy_read_struct(&png, nullptr, nullptr);
        return false;
    }
    if (setjmp(png_jmpbuf(png))) {
        png_destroy_read_struct(&png, &info, nullptr);
        return false;
    }
    png_init_io(png, f);
    png_read_info(png, info);
    png_set_strip_16(png);
    png_set_palette_to_rgb(png);
    png_set_expand_gray_1_2_4_to_8(png);
    png_set_gray_to_rgb(png);
    png_set_strip_alpha(png);
    png_read_update_info(png, info);
    out->w = png_get_image_width(png, info);
    out->h = png_get_image_height(png, info);
    out->rgb.resize(size_t(out->h) * out->w * 3);
    std::vector<png_bytep> rows(out->h);
    for (int y = 0; y < out->h; ++y)
        rows[y] = out->rgb.data() + size_t(y) * out->w * 3;
    png_read_image(png, rows.data());
    png_destroy_read_struct(&png, &info, nullptr);
    return true;
}

bool decode_file(const char* path, Image* out, int target = 0) {
    FILE* f = fopen(path, "rb");
    if (!f) return false;
    uint8_t magic[4] = {0};
    size_t got = fread(magic, 1, 4, f);
    fseek(f, 0, SEEK_SET);
    bool ok = false;
    if (got >= 3 && magic[0] == 0xFF && magic[1] == 0xD8)
        ok = decode_jpeg(f, out, target);
    else if (got >= 4 && magic[0] == 0x89 && magic[1] == 'P')
        ok = decode_png(f, out);
    fclose(f);
    return ok && out->w > 0 && out->h > 0;
}

// Separable triangle-filter resampling (PIL BILINEAR semantics: filter
// support scales with the downscale ratio — antialiased), two passes with
// precomputed weight tables, then normalize into `out`.
struct Taps {
    std::vector<int> start;     // first source index per output coord
    std::vector<int> count;     // taps per output coord
    std::vector<float> weight;  // flattened weights (max_count stride)
    int max_count = 0;
};

Taps make_taps(int in_size, int out_size) {
    Taps t;
    double scale = double(in_size) / out_size;
    double support = scale < 1.0 ? 1.0 : scale;  // triangle radius
    t.max_count = int(std::ceil(support * 2)) + 2;
    t.start.resize(out_size);
    t.count.resize(out_size);
    t.weight.assign(size_t(out_size) * t.max_count, 0.0f);
    for (int i = 0; i < out_size; ++i) {
        double center = (i + 0.5) * scale;
        int lo = (int)std::floor(center - support);
        int hi = (int)std::ceil(center + support);
        if (lo < 0) lo = 0;
        if (hi > in_size) hi = in_size;
        double inv = scale < 1.0 ? 1.0 : 1.0 / scale;
        double total = 0.0;
        int cnt = 0;
        for (int j = lo; j < hi; ++j) {
            double d = std::abs((j + 0.5 - center) * inv);
            double w = d < 1.0 ? 1.0 - d : 0.0;
            if (w > 0 || cnt > 0) {
                t.weight[size_t(i) * t.max_count + cnt] = (float)w;
                total += w;
                ++cnt;
            } else {
                ++lo;
            }
        }
        while (cnt > 0 && t.weight[size_t(i) * t.max_count + cnt - 1] == 0.0f) --cnt;
        if (cnt == 0) {  // degenerate: nearest
            lo = std::min(std::max((int)center, 0), in_size - 1);
            t.weight[size_t(i) * t.max_count] = 1.0f;
            cnt = 1;
            total = 1.0;
        }
        float norm = (float)(1.0 / total);
        for (int c = 0; c < cnt; ++c) t.weight[size_t(i) * t.max_count + c] *= norm;
        t.start[i] = lo;
        t.count[i] = cnt;
    }
    return t;
}

void resize_normalize(const Image& img, int res, bool to_m11, float* out) {
    const float scale = to_m11 ? (2.0f / 255.0f) : (1.0f / 255.0f);
    const float shift = to_m11 ? -1.0f : 0.0f;
    Taps tx = make_taps(img.w, res);
    Taps ty = make_taps(img.h, res);
    // pass 1: horizontal (h, res, 3) float; source row converted to float
    // once so the tap loop reads contiguively and vectorizes
    std::vector<float> tmp(size_t(img.h) * res * 3);
    std::vector<float> frow(size_t(img.w) * 3);
    for (int y = 0; y < img.h; ++y) {
        const uint8_t* row = img.rgb.data() + size_t(y) * img.w * 3;
        for (int i = 0; i < img.w * 3; ++i) frow[i] = row[i];
        float* trow = tmp.data() + size_t(y) * res * 3;
        for (int x = 0; x < res; ++x) {
            const float* w = &tx.weight[size_t(x) * tx.max_count];
            const float* src = frow.data() + size_t(tx.start[x]) * 3;
            float r = 0, g = 0, b = 0;
            for (int k = 0; k < tx.count[x]; ++k) {
                float wk = w[k];
                r += wk * src[3 * k];
                g += wk * src[3 * k + 1];
                b += wk * src[3 * k + 2];
            }
            trow[3 * x] = r;
            trow[3 * x + 1] = g;
            trow[3 * x + 2] = b;
        }
    }
    // pass 2: vertical + normalize
    for (int y = 0; y < res; ++y) {
        const float* w = &ty.weight[size_t(y) * ty.max_count];
        int s = ty.start[y];
        float* orow = out + size_t(y) * res * 3;
        std::memset(orow, 0, sizeof(float) * res * 3);
        for (int k = 0; k < ty.count[y]; ++k) {
            const float* trow = tmp.data() + size_t(s + k) * res * 3;
            float wk = w[k];
            for (int i = 0; i < res * 3; ++i) orow[i] += wk * trow[i];
        }
        for (int i = 0; i < res * 3; ++i) orow[i] = orow[i] * scale + shift;
    }
}

}  // namespace

extern "C" {

// Decode n images into out (n, res, res, 3) float32.
// Returns 0 on success, or 1-based index of the first failed file.
// A failed file no longer aborts the batch: the slot is flagged in
// fail_flags (when non-null) and every other file still decodes, so the
// Python side can retry just the failures through PIL (which sniffs
// formats — e.g. WebP bytes behind a .jpg name, common in web scrapes).
// Returns the number of failures (0 = clean batch).
int pd_decode_resize_batch(const char** paths, int n, int res, int to_m11,
                           float* out, int n_threads, int dct_scale,
                           int* fail_flags) {
    if (n_threads <= 0) n_threads = std::thread::hardware_concurrency();
    std::atomic<int> next(0);
    std::atomic<int> nfail(0);
    auto worker = [&] {
        for (;;) {
            int i = next.fetch_add(1);
            if (i >= n) return;
            Image img;
            if (!decode_file(paths[i], &img, dct_scale ? res : 0)) {
                nfail.fetch_add(1);
                if (fail_flags) fail_flags[i] = 1;
                continue;
            }
            resize_normalize(img, res, to_m11 != 0,
                             out + size_t(i) * res * res * 3);
        }
    };
    std::vector<std::thread> threads;
    int nt = n_threads < n ? n_threads : n;
    threads.reserve(nt);
    for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
    for (auto& t : threads) t.join();
    return nfail.load();
}

int pd_loader_version() { return 2; }

}  // extern "C"
